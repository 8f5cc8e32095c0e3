"""Batched serving example through the PyTorch/CUDA port: prefill +
decode with slot-based batching.

    PYTHONPATH=src python examples/torch_serve_batch.py [--arch mixtral-8x7b] [--device cpu]

The twin of ``examples/serve_batch.py``: a thin wrapper over the port's
serving driver (``repro_torch/launch/serve.py``) run at smoke scale:
requests with ragged prompt lengths are left-padded into a fixed slot
batch, prefilled once (through the flash-attention kernel), then decoded
step-by-step.  Uses the SWA ring-buffer KV cache when the arch defines a
window (mixtral), the RWKV/Mamba O(1) state caches for the recurrent
archs.  Without ``--device`` it runs on the CUDA device and raises when
there is none.
"""

import sys

from repro_torch.launch import serve


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--arch") for a in argv):
        argv = ["--arch", "mixtral-8x7b"] + argv
    if "--smoke" not in argv:
        argv.append("--smoke")
    serve.main(argv)


if __name__ == "__main__":
    main()
