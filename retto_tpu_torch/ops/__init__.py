"""Device ops (``ctc``, ``db_post``, ``db_pack``) and the host postprocess
copies (``contours``, ``raster``, ``det_postprocess``)."""
