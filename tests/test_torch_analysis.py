"""The port's invariant linter (``repro_torch.analysis``), held against
the JAX package's (``repro.analysis``) in the same process.

* **Engine parity** -- on the reference's own fixtures
  (``tests/test_analysis.py``) and on every file of ``src/repro_torch``:
  equal function units, equal pragmas and malformed-pragma findings,
  equal report text for equal findings, equal file lists, equal CLI exit
  codes and rule names.
* **Rule parity** -- every reference rule case has a torch twin,
  translated line for line, that the port's rule reports at the same
  (rule, line, suppressed, reason) as the reference's rule reports the
  original.
* **Torch-only cases** -- the waits the reference rule cannot see
  (``.tolist()``, ``.cpu()``, ``torch.nonzero``, ``bool(t)``, blocking
  uploads, the counted reads ...), each reachable from a
  ``ClusterServer.step`` stub, each with a clean twin.
* **The live tree is the contract** -- ``src/repro_torch`` is clean, every
  suppression carries a reason, and a planted ``.cpu()`` in the predict
  stage fails the CLI.
* **Imports** -- the package imports neither ``repro`` nor ``jax``.

Everything here is stdlib ``ast``: the file runs in a few seconds.
"""

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import analyze_paths as ref_analyze
from repro.analysis import context as ref_context
from repro.analysis import pragmas as ref_pragmas
from repro.analysis import report as ref_report
from repro.analysis import rule_names as ref_rule_names
from repro.analysis import runner as ref_runner
from repro_torch.analysis import analyze_paths, collect_py_files, rule_names
from repro_torch.analysis import context as port_context
from repro_torch.analysis import pragmas as port_pragmas
from repro_torch.analysis import report as port_report
from repro_torch.analysis import runner as port_runner

REPO_ROOT = Path(__file__).resolve().parents[1]
SRC = REPO_ROOT / "src"
PORT = SRC / "repro_torch"
RULES = frozenset(ref_rule_names())


def _reference_fixtures():
    """The reference test file's fixture sources, without importing it:
    its module-level ``_*_POS`` / ``_*_NEG`` strings, and the ``src``
    string of each test function that builds one inline."""
    tree = ast.parse((REPO_ROOT / "tests" / "test_analysis.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
        elif isinstance(node, ast.FunctionDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and \
                        isinstance(sub.value, ast.Constant) and \
                        isinstance(sub.value.value, str) and \
                        getattr(sub.targets[0], "id", "") == "src":
                    out[node.name] = sub.value.value
                    break
    return out


REF = _reference_fixtures()


def _write(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def _findings(report):
    return sorted((v.rule, v.line, v.suppressed, v.reason)
                  for v in report.violations)


# ---------------------------------------------------------------------------
# the torch twins, line for line (same line numbers as the originals)
# ---------------------------------------------------------------------------

_DONATION_POS = """
    import torch


    def scratch(buf, n):
        \"\"\"Zero the first n rows of buf.\"\"\"
        return buf[:n].zero_()

    def caller(state, n):
        head = state.buf[:n]; head.zero_()
        return state.buf.sum() + head.sum()   # stale read through the alias
"""

_DONATION_NEG = """
    import torch


    def scratch(buf, n):
        \"\"\"Zero the first n rows of buf.\"\"\"
        return buf[:n].zero_()

    def caller(state, n):
        head = state.buf[:n].clone(); head.zero_()   # a copy: no alias
        return state.buf.sum()
"""

_DONATION_REBIND = """
    import torch

    def g(buf):
        return buf

    scratch = g

    def caller(buf):
        head = buf[:4]; head.zero_()
        buf = make_new()
        return buf.sum()
"""

_PRECISION_POS = """
    import torch

    def decide(d2, eps):
        eps2 = torch.as_tensor(eps).float() ** 2   # f32 cast in core/
        return d2 <= eps2
"""

_PRECISION_NEG = """
    import torch

    def decide(d2, eps):
        eps2 = torch.as_tensor(eps, dtype=torch.float64) ** 2
        return d2 <= eps2
"""

_PRECISION_ALLOWED = """
    import torch

    def fast_merging_batch(si, sj, eps):
        si = si.to(torch.float32)
        return si
"""

_PRECISION_MIXED = """
    import torch

    def decide(d2_exact, eps):
        t = torch.tensor(eps).float()
        return d2_exact <= t             # mixed f32/f64 compare
"""

_RECOMPILE_POS = """
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kernel_ops

    def f(q):
        n = q.shape[0]
        buf = np.zeros((n, 4))               # raw data-dependent shape
        return kernel_ops.eps_count_batch(torch.as_tensor(buf))
"""

_RECOMPILE_NEG = """
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kernel_ops

    def _pow2_at_least(n, lo=8):
        return max(lo, 1 << (int(n) - 1).bit_length())

    def f(q):
        n = q.shape[0]
        cap = _pow2_at_least(n)
        buf = np.zeros((cap, 4))             # pow2-bucketed shape
        return kernel_ops.eps_count_batch(torch.as_tensor(buf))
"""

_RECOMPILE_SCALAR = """
    import torch
    from torch.library import custom_op


    @custom_op("repro_torch::k", mutates_args=())
    def k(x: torch.Tensor, *, block: int) -> torch.Tensor:
        return x.clone()

    def g(x):
        return k(x, block=x.amax().item())
"""

_RECOMPILE_SCALAR_CLEAN = _RECOMPILE_SCALAR.replace(
    "block=x.amax().item()", "block=128")

_HOTSYNC_POS = """
    import numpy as np
    import torch

    class ClusterServer:
        def step(self, batch):
            return helper(batch)

    def helper(batch):
        d2dev = torch.zeros(4, device="cuda")
        return float(np.asarray(d2dev))      # sync inside the hot graph
"""

_HOTSYNC_NEG = """
    import numpy as np
    import torch

    class ClusterServer:
        def step(self, batch):
            return pack(batch)

    def pack(batch):
        return np.asarray(batch, np.int32)   # host value: not a sync

    def offline_report(res):
        d2dev = torch.zeros(4, device="cuda")
        return float(np.asarray(d2dev))      # not reachable from step
"""

_HOTSYNC_SYNCHRONIZE = """
    class ClusterServer:
        def step(self, batch):
            out = launch(batch)
            torch.cuda.synchronize()
            return out
"""

_SENTINEL_POS = """
    import torch

    def row_min_wrapper(d2):
        return torch.amin(d2, dim=-1)        # raw reduce over padded buf
"""

_SENTINEL_NEG = """
    import torch

    def row_min_wrapper(d2, valid):
        d2m = torch.where(valid, d2, torch.inf)
        return torch.amin(d2m, dim=-1)
"""

# the kernel body is CUDA C++ (not read by the Python linter); the
# Python side only launches it
_SENTINEL_BODY_PY = """
    import torch

    def row_min(lib, a, out):
        lib.row_min_kernel(a.data_ptr(), out.data_ptr(), *a.shape)
"""

_SENTINEL_BODY_CU = """
    __global__ void row_min_kernel(const float* a, float* out, int m, int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i >= m) return;
      float best = a[(size_t)i * n];
      for (int j = 1; j < n; ++j) best = fminf(best, a[(size_t)i * n + j]);
      out[i] = best;
    }
"""


def _pragma(src, old, new):
    assert old in src
    return src.replace(old, new)


_DON_PRAGMA = ("  # grit-lint: disable=donation-aliasing -- "
               "buffer re-uploaded below")
_PREC_PRAGMA = ("  # grit-lint: disable=f64-discipline -- "
                "certain-only path, band applied")
_REC_PRAGMA = ("        # grit-lint: disable=recompile-hazard -- "
               "cold path, runs once\n")
_HOT_PRAGMA = ("  # grit-lint: disable=hot-path-sync -- "
               "the stage's intended block point")
_SEN_PRAGMA = ("  # grit-lint: disable=sentinel-mask -- "
               "caller FAR-folds per contract")

# (case, reference files, port files, rules selected); the reference's
# sources are its test file's own, the pragma variants made with the
# same replacements its tests make
CASES = [
    ("donation-positive", {"m.py": REF["_DONATION_POS"]},
     {"m.py": _DONATION_POS}, "donation-aliasing"),
    ("donation-negative", {"m.py": REF["_DONATION_NEG"]},
     {"m.py": _DONATION_NEG}, "donation-aliasing"),
    ("donation-pragma",
     {"m.py": _pragma(REF["_DONATION_POS"],
                      "   # stale read of donated buf", _DON_PRAGMA)},
     {"m.py": _pragma(_DONATION_POS, "   # stale read through the alias",
                      _DON_PRAGMA)}, "donation-aliasing"),
    ("donation-rebind-before-read",
     {"m.py": REF["test_donation_rebind_before_read_is_clean"]},
     {"m.py": _DONATION_REBIND}, "donation-aliasing"),
    ("precision-positive", {"core/foo.py": REF["_PRECISION_POS"]},
     {"core/foo.py": _PRECISION_POS}, "f64-discipline"),
    ("precision-out-of-scope", {"serve/foo.py": REF["_PRECISION_POS"]},
     {"serve/foo.py": _PRECISION_POS}, "f64-discipline"),
    ("precision-negative",
     {"core/foo.py": REF["test_precision_negative_f64_in_core"]},
     {"core/foo.py": _PRECISION_NEG}, "f64-discipline"),
    ("precision-allowlisted",
     {"core/merging.py": REF["test_precision_allowlisted_dispatch_is_clean"]},
     {"core/merging.py": _PRECISION_ALLOWED}, "f64-discipline"),
    ("precision-mixed-compare",
     {"index/foo.py": REF["test_precision_mixed_compare"]},
     {"index/foo.py": _PRECISION_MIXED}, "f64-discipline"),
    ("precision-pragma",
     {"core/foo.py": _pragma(REF["_PRECISION_POS"],
                             "          # f32 cast in core/", _PREC_PRAGMA)},
     {"core/foo.py": _pragma(_PRECISION_POS, "   # f32 cast in core/",
                             _PREC_PRAGMA)}, "f64-discipline"),
    ("recompile-positive", {"m.py": REF["_RECOMPILE_POS"]},
     {"m.py": _RECOMPILE_POS}, "recompile-hazard"),
    ("recompile-negative", {"m.py": REF["_RECOMPILE_NEG"]},
     {"m.py": _RECOMPILE_NEG}, "recompile-hazard"),
    ("recompile-static-argument",
     {"m.py": REF["test_recompile_static_argnames_array"]},
     {"m.py": _RECOMPILE_SCALAR}, "recompile-hazard"),
    ("recompile-static-scalar-clean",
     {"m.py": REF["test_recompile_static_argnames_scalar_is_clean"]},
     {"m.py": _RECOMPILE_SCALAR_CLEAN}, "recompile-hazard"),
    ("recompile-pragma",
     {"m.py": _pragma(REF["_RECOMPILE_POS"], "        return kernel_ops",
                      _REC_PRAGMA + "        return kernel_ops")},
     {"m.py": _pragma(_RECOMPILE_POS, "        return kernel_ops",
                      _REC_PRAGMA + "        return kernel_ops")},
     "recompile-hazard"),
    ("hotsync-positive", {"m.py": REF["_HOTSYNC_POS"]},
     {"m.py": _HOTSYNC_POS}, "hot-path-sync"),
    ("hotsync-negative", {"m.py": REF["_HOTSYNC_NEG"]},
     {"m.py": _HOTSYNC_NEG}, "hot-path-sync"),
    ("hotsync-block-until-ready",
     {"m.py": REF["test_hotsync_block_until_ready_flags"]},
     {"m.py": _HOTSYNC_SYNCHRONIZE}, "hot-path-sync"),
    ("hotsync-pragma",
     {"m.py": _pragma(REF["_HOTSYNC_POS"],
                      "      # sync inside the hot graph", _HOT_PRAGMA)},
     {"m.py": _pragma(_HOTSYNC_POS, "      # sync inside the hot graph",
                      _HOT_PRAGMA)}, "hot-path-sync"),
    ("sentinel-positive", {"kernels/foo.py": REF["_SENTINEL_POS"]},
     {"kernels/foo.py": _SENTINEL_POS}, "sentinel-mask"),
    ("sentinel-negative", {"kernels/foo.py": REF["_SENTINEL_NEG"]},
     {"kernels/foo.py": _SENTINEL_NEG}, "sentinel-mask"),
    ("sentinel-out-of-scope", {"serve/foo.py": REF["_SENTINEL_POS"]},
     {"serve/foo.py": _SENTINEL_POS}, "sentinel-mask"),
    ("sentinel-kernel-body",
     {"kernels/foo.py": REF["test_sentinel_kernel_body_exempt"]},
     {"kernels/foo.py": _SENTINEL_BODY_PY,
      "kernels/csrc/foo.cu": _SENTINEL_BODY_CU}, "sentinel-mask"),
    ("sentinel-pragma",
     {"kernels/foo.py": _pragma(REF["_SENTINEL_POS"],
                                "          # raw reduce over padded buf",
                                _SEN_PRAGMA)},
     {"kernels/foo.py": _pragma(_SENTINEL_POS,
                                "        # raw reduce over padded buf",
                                _SEN_PRAGMA)}, "sentinel-mask"),
    ("pragma-without-reason",
     {"kernels/foo.py": _pragma(REF["_SENTINEL_POS"],
                                "          # raw reduce over padded buf",
                                "  # grit-lint: disable=sentinel-mask")},
     {"kernels/foo.py": _pragma(_SENTINEL_POS,
                                "        # raw reduce over padded buf",
                                "  # grit-lint: disable=sentinel-mask")},
     "sentinel-mask"),
    ("pragma-unknown-rule",
     {"kernels/foo.py": _pragma(REF["_SENTINEL_POS"],
                                "          # raw reduce over padded buf",
                                "  # grit-lint: disable=no-such-rule -- "
                                "whatever")},
     {"kernels/foo.py": _pragma(_SENTINEL_POS,
                                "        # raw reduce over padded buf",
                                "  # grit-lint: disable=no-such-rule -- "
                                "whatever")}, "sentinel-mask"),
]


@pytest.mark.parametrize("case,ref_files,port_files,rule", CASES,
                         ids=[c[0] for c in CASES])
def test_rule_twin_reported_like_the_reference(tmp_path, case, ref_files,
                                               port_files, rule):
    _write(tmp_path / "ref", ref_files)
    _write(tmp_path / "port", port_files)
    want = _findings(ref_analyze([str(tmp_path / "ref")], select=[rule]))
    got = _findings(analyze_paths([str(tmp_path / "port")], select=[rule]))
    assert got == want
    # the twin is not vacuous: positives report, negatives do not
    assert bool(want) == any(k in case for k in (
        "positive", "pragma", "mixed", "block", "static-argument"))


# ---------------------------------------------------------------------------
# torch-only hot-path-sync cases: reachable positives, clean twins
# ---------------------------------------------------------------------------

_STEP = """
    import numpy as np
    import torch
    from repro_torch.core import sync
    from repro_torch.core.sync import host_read

    class ClusterServer:
        def step(self, batch):
            return helper(batch, torch.device("cuda"))

    def helper(batch, dev):
        mask_dev = torch.zeros(4, dtype=torch.bool, device=dev)
        d2dev = torch.zeros(4, device=dev)
        {hot}

    def offline(batch, dev):
        mask_dev = torch.zeros(4, dtype=torch.bool, device=dev)
        d2dev = torch.zeros(4, device=dev)
        {cold}
"""

# (name, a line that waits for the card, a clean twin: the same wait
# unreachable from step, or the call on host data)
TORCH_ONLY = [
    ("tolist", "return d2dev.tolist()", None),
    ("cpu", "return d2dev.cpu()", None),
    ("numpy", "return d2dev.numpy()", None),
    ("to-cpu", "return d2dev.to('cpu')", None),
    ("item", "return d2dev.sum().item()", None),
    ("torch-nonzero", "return torch.nonzero(mask_dev)",
     "return np.flatnonzero(np.asarray(batch))"),
    ("method-nonzero", "return mask_dev.nonzero()", None),
    ("unique", "return torch.unique(d2dev)",
     "return np.unique(np.asarray(batch))"),
    ("masked-select", "return d2dev.masked_select(mask_dev)", None),
    ("bool", "return bool(mask_dev.any())", "return bool(len(batch))"),
    ("int", "return int(d2dev.argmin())", "return int(len(batch))"),
    ("blocking-to", "return torch.from_numpy(batch).to(dev)",
     "return torch.from_numpy(batch).to(dev, non_blocking=True)"),
    ("blocking-cuda", "return torch.from_numpy(batch).cuda()",
     "return torch.from_numpy(batch).cuda(non_blocking=True)"),
    ("blocking-as-tensor", "return torch.as_tensor(batch, device=dev)",
     "return torch.as_tensor(batch, dtype=torch.float64)"),
    ("synchronize", "return torch.cuda.synchronize(dev)", None),
    ("event-synchronize", "return torch.cuda.Event().synchronize()", None),
    ("host-read", "return host_read(mask_dev.sum())", None),
    ("sync-host-read", "return sync.host_read(mask_dev.sum())", None),
    ("count-read", "return sync.count_read()", None),
]


@pytest.mark.parametrize("name,hot,clean", TORCH_ONLY,
                         ids=[c[0] for c in TORCH_ONLY])
def test_torch_sync_reachable_from_step_is_reported(tmp_path, name, hot,
                                                    clean):
    """Each wait is reported once, on its line, in the reachable helper;
    the same wait unreachable from step (or its host twin) is clean."""
    src = _STEP.format(hot=hot, cold=hot)
    _write(tmp_path / "pos", {"serve/m.py": src})
    report = analyze_paths([str(tmp_path / "pos")], select=["hot-path-sync"])
    line = textwrap.dedent(src).splitlines().index(f"    {hot}") + 1
    assert [(v.line, "helper()" in v.message) for v in report.active] == \
        [(line, True)], report.format()
    # the clean twin: the host-data variant where there is one, else
    # the same call only in the unreachable function
    twin = _STEP.format(hot=clean or "return batch", cold=hot)
    _write(tmp_path / "neg", {"serve/m.py": twin})
    report = analyze_paths([str(tmp_path / "neg")], select=["hot-path-sync"])
    assert report.ok, report.format()


def test_stage_roots_are_the_device_state_dispatch_stages(tmp_path):
    """A wait in a DeviceState dispatch stage is reported with no
    ClusterServer in the tree; the same function elsewhere is not a root."""
    src = """
        def predict_device_async(index, ds, q, stats):
            return ds.points_res.cpu()
    """
    _write(tmp_path / "a", {"index/device_state.py": src})
    _write(tmp_path / "b", {"index/other.py": src})
    hit = analyze_paths([str(tmp_path / "a")], select=["hot-path-sync"])
    miss = analyze_paths([str(tmp_path / "b")], select=["hot-path-sync"])
    assert [v.line for v in hit.active] == [3] and miss.ok


def test_kernel_body_has_no_exemption_in_the_port(tmp_path):
    """The JAX package exempts Pallas bodies (``*_ref`` parameters); the
    port's bodies are CUDA C++, so a Python function of that shape is
    held to the rule like any other."""
    src = REF["test_sentinel_kernel_body_exempt"].replace(
        "import jax.numpy as jnp", "import torch").replace(
        "jnp.min(a_ref[...], axis=-1)", "torch.amin(a_ref[...], dim=-1)")
    _write(tmp_path, {"kernels/foo.py": src})
    report = analyze_paths([str(tmp_path)], select=["sentinel-mask"])
    assert [v.line for v in report.active] == [5]


def test_operator_scalar_arguments_come_from_the_schema(tmp_path):
    """``torch.ops.repro_torch.*`` takes its scalar arguments from the
    ``_kernel_op`` schema of ``kernels/ops.py``, and a wrapper's from the
    parameters that reach them."""
    ops = '''
        import torch

        @_kernel_op("count", "(Tensor a, float eps2, int stop_at) -> Tensor")
        def _count_op(a, eps2, stop_at):
            return a

        def count(a, eps, *, stop_at=None):
            return torch.ops.repro_torch.count(a, _eps2(eps), int(stop_at))
    '''
    caller = '''
        import torch
        from repro_torch.kernels import ops as kernel_ops

        def f(a, t):
            kernel_ops.count(a, t.max().item(), stop_at=4)
            kernel_ops.count(a, 0.5, stop_at=int(t.sum()))
            torch.ops.repro_torch.count(a, float(t.amax()), 8)
            return kernel_ops.count(a, 0.5, stop_at=4)
    '''
    _write(tmp_path, {"kernels/ops.py": ops, "serve/m.py": caller})
    report = analyze_paths([str(tmp_path)], select=["recompile-hazard"])
    assert sorted((v.line, v.message.split("'")[1])
                  for v in report.active) == [
        (6, "eps"), (7, "stop_at"), (8, "eps2")], report.format()


def test_donation_writes_through_out_and_subscript(tmp_path):
    src = """
        import torch

        def f(x, y, n):
            head = x[:n]
            torch.add(y, 1, out=head)
            a = x.sum()
            flat = y.view(-1)
            flat[0] = 1.0
            return y.sum() + a
    """
    _write(tmp_path, {"m.py": src})
    report = analyze_paths([str(tmp_path)], select=["donation-aliasing"])
    assert [v.line for v in report.active] == [7, 10], report.format()


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

PORT_FILES = [os.path.relpath(p, PORT) for p in collect_py_files([str(PORT)])]
FIXTURES = sorted(k for k in REF if k.startswith("_"))


def _units(ctx_mod, path, relpath, source):
    mod = ctx_mod.build_module(path, relpath, source)
    return [(u.qualname, u.node.lineno, sorted(u.called_names))
            for u in mod.units]


def _pragmas(prag_mod, path, lines):
    good, bad = prag_mod.parse_pragmas(path, lines, known_rules=RULES)
    return ({k: (sorted(p.rules), p.reason) for k, p in good.items()},
            [(v.rule, v.line, v.col, v.message) for v in bad])


@pytest.mark.parametrize("source", FIXTURES + PORT_FILES)
def test_engine_parity_units_and_pragmas(source):
    if source in REF:
        text, relpath = textwrap.dedent(REF[source]), "m.py"
    else:
        text, relpath = (PORT / source).read_text(), source
    assert _units(port_context, source, relpath, text) == \
        _units(ref_context, source, relpath, text)
    lines = text.splitlines()
    assert _pragmas(port_pragmas, source, lines) == \
        _pragmas(ref_pragmas, source, lines)


def test_engine_parity_malformed_pragmas():
    lines = ["x = 1  # grit-lint: disable=hot-path-sync",
             "y = 2  # grit-lint: disable=no-such-rule -- why",
             "# grit-lint: disable=all -- everything below",
             "z = 3  # grit-lint: disable=f64-discipline,sentinel-mask -- two"]
    got = _pragmas(port_pragmas, "p.py", lines)
    assert got == _pragmas(ref_pragmas, "p.py", lines)
    assert [m[1] for m in got[1]] == [1, 2] and sorted(got[0]) == [3, 4]


def test_engine_parity_report_format():
    """Equal findings give equal report text, with and without the
    suppressed ones, clean or not."""
    rows = [("hot-path-sync", "b.py", 9, 4, "m1", True, "why"),
            ("f64-discipline", "a.py", 3, 0, "m2", False, ""),
            ("pragma", "a.py", 3, 0, "m3", False, ""),
            ("sentinel-mask", "a.py", 1, 8, "m4", True, "fold")]
    for sel in (rows, [r for r in rows if r[5]], []):
        reports = [mod.Report(violations=[mod.Violation(*r) for r in sel],
                              files_checked=7)
                   for mod in (ref_report, port_report)]
        for show in (False, True):
            assert reports[0].format(show) == reports[1].format(show)
        assert reports[0].ok == reports[1].ok
        assert reports[0].counts_by_rule() == reports[1].counts_by_rule()


def test_engine_parity_collect_py_files(tmp_path):
    _write(tmp_path, {"a.py": "", "b/c.py": "", "b/d.txt": "",
                      ".hidden/e.py": "", "__pycache__/f.py": "",
                      "g/.h/i.py": ""})
    for paths in ([str(tmp_path)], [str(SRC)], [str(PORT)],
                  [str(tmp_path / "a.py"), str(tmp_path)],
                  [str(tmp_path / "b" / "d.txt")]):
        assert port_runner.collect_py_files(paths) == \
            ref_runner.collect_py_files(paths)
    assert port_runner.split_selection(" a,b , c,") == \
        ref_runner.split_selection(" a,b , c,")


def test_engine_parity_syntax_error_and_unknown_select(tmp_path):
    _write(tmp_path, {"broken.py": "def f(:\n"})
    got = analyze_paths([str(tmp_path)])
    want = ref_analyze([str(tmp_path)])
    assert _findings(got) == _findings(want) and \
        [v.rule for v in got.active] == ["parse"]
    with pytest.raises(KeyError):
        analyze_paths([str(tmp_path)], select=["no-such-rule"])


def _cli(pkg, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", f"{pkg}.analysis", *args],
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_cli_parity(tmp_path):
    """Exit codes 0 / 1 / 2 as the reference's, and the same rule names."""
    clean = tmp_path / "clean.py"
    clean.write_text("def f(x):\n    return x + 1\n")
    _write(tmp_path / "bad", {"kernels/bad.py": "def f(d2):\n"
                                                "    return d2.min()\n"})
    for args, rc in ((("--check", str(clean)), 0),
                     (("--check", str(tmp_path / "bad")), 1),
                     ((), 2),
                     (("--check", str(clean), "--select", "nope"), 2)):
        assert _cli("repro", *args).returncode == rc
        assert _cli("repro_torch", *args).returncode == rc, args
    listed = [_cli(pkg, "--list-rules") for pkg in ("repro", "repro_torch")]
    assert [p.returncode for p in listed] == [0, 0]
    names = [sorted(line.split(":")[0] for line in p.stdout.splitlines())
             for p in listed]
    assert names[0] == names[1] == sorted(rule_names())
    assert set(rule_names()) == {
        "donation-aliasing", "f64-discipline", "hot-path-sync",
        "recompile-hazard", "sentinel-mask"}


# ---------------------------------------------------------------------------
# the live tree is the contract
# ---------------------------------------------------------------------------

def test_live_tree_is_clean():
    report = analyze_paths([str(PORT)])
    assert report.files_checked > 80
    assert report.ok, "live src/repro_torch must have zero unsuppressed " \
        "violations:\n" + report.format()
    assert report.suppressed, "the known block points should be pragma'd"
    for v in report.suppressed:
        assert v.reason.strip(), v.format()
    # a hot-path wait is either a stage's intended block point or a
    # known one, listed for removal
    for v in report.suppressed:
        if v.rule == "hot-path-sync":
            assert v.reason.startswith("KNOWN:") or \
                "block point" in v.reason, v.format()


def test_cli_on_the_live_tree_and_a_planted_sync(tmp_path):
    """The CLI exits 0 on the live tree, lists every suppression with its
    reason, and exits 1 when a ``.cpu()`` is planted in the predict
    stage of a copy."""
    proc = _cli("repro_torch", "--check", str(PORT), "--show-suppressed")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    sup = [ln for ln in proc.stdout.splitlines() if "suppressed (" in ln]
    assert sup and all("suppressed ()" not in ln for ln in sup)
    copy = tmp_path / "repro_torch"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns("__pycache__"))
    ds = copy / "index" / "device_state.py"
    text = ds.read_text()
    old = "    return predict_device_async(index, ds, q, stats)()\n"
    assert old in text
    ds.write_text(text.replace(old, "    ds.points_res.cpu()\n" + old))
    proc = _cli("repro_torch", "--check", str(copy))
    assert proc.returncode == 1, proc.stdout
    assert "predict_device()" in proc.stdout and ".cpu()" in proc.stdout


def test_analysis_imports_neither_repro_nor_jax():
    pkg = PORT / "analysis"
    files = collect_py_files([str(pkg)])
    assert len(files) == len(collect_py_files([str(SRC / "repro" / "analysis")]))
    for path in files:
        tree = ast.parse(Path(path).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("repro", "jax", "jaxlib"), (path, name)
                assert top in sys.stdlib_module_names or \
                    top == "__future__", (path, name)
