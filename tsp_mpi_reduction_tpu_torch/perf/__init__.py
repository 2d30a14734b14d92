"""Performance layers of the port: the graph store (``compile_cache``),
the root-ascent memo (``ascent_memo``) and the in-place frontier writes
(``donation``)."""
