"""Traffic: the page generator, its glyph bank and the mixes (data files)."""
