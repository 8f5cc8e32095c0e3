"""Flash attention of the port against the reference.

On the CPU the port's ``kernels.ops.flash_attention`` takes its plain
version (``flash_attention_plain``); it is held against the reference's
``repro.kernels.ops.flash_attention`` (the Pallas kernel, in interpret
mode on the CPU) and against the reference's oracle ``ref.mha``, on the
shapes of ``tests/test_kernels.py``'s flash sweep plus head_dim 80 and
single-query decode, within 2e-4 (float32) and 2e-2 (bfloat16), the
sweep's tolerances.  The port's own ``ref.mha`` is held to the
reference's.  k / v with fewer heads than q (GQA) give what their
broadcast gives.  The bf16 kernel's product of P with V is emulated here
to show why it splits P into two bf16 terms.  The CUDA kernel is held to
the plain version on the card (``gpu`` marker here; ``chip_smoke.py``
phase ``flash`` at the model's shapes).
"""

import zlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops as tops, ref as tref
from repro_torch.models.layers import _broadcast_kv

# (b, h, sq, sk, dh, causal, window, softcap)
SHAPES = [
    (2, 3, 64, 64, 32, True, None, None),
    (1, 2, 128, 128, 64, True, 32, None),
    (1, 2, 100, 100, 64, True, None, 50.0),
    (2, 1, 1, 96, 32, True, None, None),          # decode
    (1, 2, 80, 80, 64, False, None, None),        # encoder
    (1, 1, 64, 192, 32, True, None, None),        # chunked prefix
    (1, 2, 256, 256, 64, True, 128, 30.0),        # SWA + softcap
    (1, 2, 96, 96, 80, True, None, None),         # stablelm head_dim
    (2, 2, 1, 130, 80, True, 64, None),           # decode, head_dim 80
    (2, 2, 32, 24, 16, False, None, None),        # cross, Sq > Sk
    (1, 2, 24, 150, 64, False, None, None),       # cross, ragged Sk
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# the CUDA kernel against its plain version, (rtol, atol): in bfloat16 both
# round the same float32 function, so one bf16 ulp of the output (<= 2^-7
# of it) plus the float32 rounding of the sums
CARD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2.0 ** -7, 1e-4)}
# chip_smoke.py's mean bound: mean |got - want| <= FLASH_MEAN_REL * mean |want|
FLASH_MEAN_REL = 1e-3
# (H, H_kv): qwen2-1.5b's 12 / 2, internvl2-1b's 14 / 2, a group of 2,
# multi-query
GQA_HEADS = [(12, 2), (14, 2), (8, 4), (6, 1)]


def _inputs(shape, dtype):
    b, h, sq, sk, dh = shape[:5]
    rng = np.random.default_rng(zlib.crc32(repr((shape, dtype)).encode()))
    arrs = [rng.normal(size=(b, h, n, dh)).astype(np.float32)
            for n in (sq, sk, sk)]
    jd, td, tol = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs], tol)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_flash_matches_the_reference_kernel(shape, dtype):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(shape, dtype)
    causal, window, cap = shape[5:]
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window,
                               softcap=cap)
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(tq.shape)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                softcap=cap)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_flash_and_mha_match_the_reference_oracle(shape, dtype):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(shape, dtype)
    causal, window, cap = shape[5:]
    want = jref.mha(jq, jk, jv, causal=causal, window=window, softcap=cap)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window,
                               softcap=cap)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    oracle = tref.mha(tq, tk, tv, causal=causal, window=window, softcap=cap)
    assert oracle.dtype == tv.dtype
    np.testing.assert_allclose(_np(oracle), _np(want), rtol=tol, atol=tol)


def test_plain_version_is_chunked_over_query_rows(monkeypatch):
    """Chunking the plain version's query rows changes nothing beyond the
    float32 rounding of the matrix products."""
    (_, _, _), (q, k, v), _ = _inputs((1, 2, 100, 100, 64, True, 16, 30.0),
                                      "float32")
    whole = tops.flash_attention_plain(q, k, v, window=16, softcap=30.0)
    monkeypatch.setattr(tops, "PLAIN_CHUNK_ELEMS", 2 * 100 * 7)
    parts = tops.flash_attention_plain(q, k, v, window=16, softcap=30.0)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_rows_without_a_live_key_are_zero():
    """Sq > Sk under the causal mask leaves the first Sq - Sk rows with no
    live key: the kernel and its plain version write 0 there."""
    (_, _, _), (q, k, v), _ = _inputs((1, 1, 9, 4, 16, True, None, None),
                                      "float32")
    out = tops.flash_attention(q, k, v)
    assert torch.all(out[:, :, :5] == 0)
    assert torch.all(out[:, :, 5:].abs().sum(-1) > 0)
    empty = tops.flash_attention(q, k[:, :, :0], v[:, :, :0])
    assert torch.all(empty == 0)


def test_cpu_tensors_never_launch_and_bad_shapes_raise():
    (_, _, _), (q, k, v), _ = _inputs(SHAPES[0], "float32")
    before = dict(tops.LAUNCHES)
    assert "flash_attention" in before
    tops.flash_attention(q, k, v)
    assert tops.LAUNCHES == before
    with pytest.raises(ValueError):
        tops.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, v[:, :, :10])
    with pytest.raises(ValueError):
        tops.flash_attention(q, k[..., :16], v[..., :16])


@pytest.mark.parametrize("form, passes", [("two_terms", True),
                                         ("one_rounding", False)])
def test_pv_product_needs_p_as_two_bf16_terms(form, passes):
    """The bf16 kernel multiplies P into V on bf16 tensor cores.  Emulated
    in float32 on the CPU at [1,4,1024,128] causal: with P as two bf16
    terms (P_hi = bf16(P), P_lo = bf16(P - P_hi), both into one float32
    sum) the output stays within the card tolerance of the float32-p
    function that the plain version computes; with P rounded to bf16 once
    it does not (about 40 % of the outputs move by an ulp, some by many)."""
    rng = np.random.default_rng(zlib.crc32(b"pv-product"))
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 1024, 128))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    logits, _ = tref.masked_logits(q, k, q_offset=0, causal=True,
                                   window=None, softcap=None,
                                   scale=128 ** -0.5)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    vf = v.to(torch.float32)
    want = ((p @ vf) / l).to(torch.bfloat16).to(torch.float32)
    hi = p.to(torch.bfloat16).to(torch.float32)
    o = hi @ vf
    if form == "two_terms":
        o = o + (p - hi).to(torch.bfloat16).to(torch.float32) @ vf
    got = (o / l).to(torch.bfloat16).to(torch.float32)
    rtol, atol = CARD_TOL["bfloat16"]
    diff = (got - want).abs()
    worst = float((diff / (rtol * want.abs() + atol)).max())
    mean_rel = float(diff.mean() / want.abs().mean())
    assert (worst <= 1.0 and mean_rel <= FLASH_MEAN_REL) == passes, \
        (worst, mean_rel)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("heads", GQA_HEADS, ids=lambda h: f"{h[0]}q{h[1]}kv")
def test_kv_heads_read_in_place_equal_their_broadcast(heads, dtype):
    """k / v with H_kv < H heads give, in the plain version and the
    wrapper, exactly what the model's broadcast copy gives, and match the
    reference kernel run on the broadcast copy."""
    H, Hkv = heads
    rng = np.random.default_rng(zlib.crc32(repr((heads, dtype)).encode()))
    q, k, v = (rng.normal(size=(2, h, n, 32)).astype(np.float32)
               for h, n in ((H, 40), (Hkv, 56), (Hkv, 56)))
    jd, td, tol = DTYPES[dtype]
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    kb, vb = (_broadcast_kv(t, H // Hkv) for t in (tk, tv))
    kw = dict(causal=True, window=24, softcap=30.0)
    for fn in (tops.flash_attention_plain, tops.flash_attention):
        got = fn(tq, tk, tv, **kw)
        assert torch.equal(got, fn(tq, kb, vb, **kw))
    want = jops.flash_attention(jnp.asarray(q, jd),
                                jnp.asarray(_np(kb), jd),
                                jnp.asarray(_np(vb), jd), **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_kv_heads_that_do_not_divide_the_query_heads_raise():
    q = torch.zeros((1, 12, 8, 16))
    for kv_heads in (5, 24, 0):
        k = torch.zeros((1, kv_heads, 8, 16))
        with pytest.raises(ValueError):
            tops.flash_attention(q, k, k)


@pytest.mark.gpu
def test_cuda_flash_kernel_matches_its_plain_version_on_the_card():
    """The hand-written kernel against its plain version on a CUDA device
    (skipped where there is none), float32 and bfloat16, with a window,
    a soft-cap, ragged tiles, non-causal with more queries than keys
    (a cross-attention's), and k / v with fewer heads than q at head dim
    80."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    for shape in ((1, 2, 100, 100, 64, True, 32, 30.0),
                  (2, 3, 1, 130, 80, True, None, None),
                  (1, 2, 70, 200, 128, False, None, None),
                  (1, 4, 300, 150, 64, False, None, None),
                  (2, 12, 200, 200, 80, True, None, None)):
        for dtype in DTYPES:
            _, (q, k, v), _ = _inputs(shape, dtype)
            if shape[1] == 12:          # 2 KV heads for 12 query heads
                k, v = k[:, :2].contiguous(), v[:, :2].contiguous()
            rtol, atol = CARD_TOL[dtype]
            causal, window, cap = shape[5:]
            before = tops.LAUNCHES["flash_attention"]
            got = tops.flash_attention(q.cuda(), k.cuda(), v.cuda(),
                                       causal=causal, window=window,
                                       softcap=cap)
            assert tops.LAUNCHES["flash_attention"] == before + 1
            want = tops.flash_attention_plain(q, k, v, causal=causal,
                                              window=window, softcap=cap)
            np.testing.assert_allclose(_np(got.cpu()), _np(want), rtol=rtol,
                                       atol=atol)


def test_each_source_gets_its_own_flags_in_its_hash():
    """``-fmad=false`` (exact distance terms) applies to the distance
    kernels only; both sources keep ptxas's report (``-Xptxas -v``) of
    registers and spills; the library name hashes the source's own
    flags."""
    from repro_torch.kernels import build
    assert build.sources() == ["flash_attention", "pairwise"]
    assert "-fmad=false" in build.flags("pairwise")
    assert "-fmad=false" not in build.flags("flash_attention")
    for name in build.sources():
        assert "arch=compute_90a,code=sm_90a" in build.flags(name)
        flags = build.flags(name)
        assert ("-Xptxas", "-v") in zip(flags, flags[1:])
        _, lib = build._target(name)
        assert lib.name.startswith(f"lib{name}-") and lib.suffix == ".so"


def test_another_version_of_a_source_builds_under_its_own_name(tmp_path):
    """``build.load_source`` names a second build of a kernel source (the
    parent's ``pairwise.cu``, timed beside the current one) by its own
    name, its text and the flags of the source it stands in for."""
    from repro_torch.kernels import build
    other = tmp_path / "pairwise_old.cu"
    other.write_text('#include <stdint.h>\nextern "C" int f() { return 0; }\n')
    src, lib = build._target("pairwise_baseline", other, "pairwise")
    assert src == other and lib.name.startswith("libpairwise_baseline-")
    assert lib != build._target("pairwise")[1]
    same = build._target("pairwise_baseline", other, "pairwise")[1]
    assert same == lib
    assert build._target("pairwise_baseline", other, "flash_attention")[1] \
        != lib


def test_an_edited_header_changes_the_library_name(tmp_path, monkeypatch):
    """The library name hashes every local header a source includes,
    directly or through another header, so an edited header never meets a
    stale library."""
    from repro_torch.kernels import build
    assert [p.name for p in build.headers(build.CSRC / "flash_attention.cu")] \
        == ["sm90.cuh"]
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.headers(tmp_path / "k.cu")] == ["a.cuh",
                                                                  "b.cuh"]
    first = build._target("k")[1].name
    assert build._target("k")[1].name == first
    (tmp_path / "b.cuh").write_text("int b2;\n")
    second = build._target("k")[1].name
    assert second != first and second.startswith("libk-")
    assert build.log_path("k") == build._target("k")[1].with_suffix(".log")
