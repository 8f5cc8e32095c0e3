"""Assigned input-shape sets (same four for every LM arch).

``train_*`` shapes lower ``train_step``; ``decode_*`` / ``long_*`` lower
``serve_step`` (one new token against a KV cache of seq_len);
``prefill_*`` lowers the prefill graph.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524_288, 1),
}


def get_shape(name: str) -> ShapeCfg:
    return SHAPES[name]
