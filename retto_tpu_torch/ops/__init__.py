"""Device ops (``ctc``, ``db_post``, ``db_pack``) and the host postprocess
copies (``contours``, ``raster``, ``det_postprocess``), which export what
``retto_tpu/ops/__init__.py`` exports."""

from .contours import find_contour_point_sets
from .det_postprocess import det_postprocess
from .raster import box_score_fast, fill_convex_quad

__all__ = [
    "find_contour_point_sets",
    "det_postprocess",
    "box_score_fast",
    "fill_convex_quad",
]
