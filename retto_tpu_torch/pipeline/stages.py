"""Bucket helpers of the pipeline stages.

Port copy of ``_bucket_up`` (retto_tpu/pipeline/stages.py:45),
``det_input_dims`` (:49-61) and ``_next_bucket`` (:165).  The staged
COMPAT session that the rest of that module serves is not ported yet.
"""

from __future__ import annotations

import bisect
import math
from typing import Sequence

from ..image.resize import resize_either_dims

__all__ = ["det_input_dims"]


def _bucket_up(v: int, step: int, cap: int) -> int:
    return min(int(math.ceil(v / step)) * step, cap)


def det_input_dims(
    ah: int, aw: int, limit_type, limit_side_len: int, max_side: int
) -> tuple[int, int]:
    """resize_either dims clamped so both dims fit the det bucket cap
    (BucketConfig.det_max_side).  The clamp only triggers on extreme
    aspect-ratio upscales (e.g. a 640x200 input explodes to 2368 px wide
    under the reference's min-side-736 rule); the result stays /32."""
    rh, rw = resize_either_dims(ah, aw, limit_type, limit_side_len)
    if max(rh, rw) > max_side:
        scale = max_side / max(rh, rw)
        rh = max(int(rh * scale) // 32, 1) * 32
        rw = max(int(rw * scale) // 32, 1) * 32
    return rh, rw


def _next_bucket(v: int, buckets: Sequence[int]) -> int:
    pos = bisect.bisect_left(buckets, v)
    return buckets[pos] if pos < len(buckets) else buckets[-1] * (
        (v + buckets[-1] - 1) // buckets[-1]
    )
