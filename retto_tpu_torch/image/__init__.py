from .io import ImageHelper, decode_image
from .resize import rec_resize_dims, resize_both_dims, resize_either_dims

__all__ = [
    "ImageHelper",
    "decode_image",
    "resize_both_dims",
    "resize_either_dims",
    "rec_resize_dims",
]
