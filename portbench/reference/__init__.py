"""Plain references, one per driver, in plain PyTorch and NumPy. They import
nothing of ``yagi_tpu_torch`` (nor ``jax`` or ``yagi_tpu``) and take nothing
the program derived: designs, banks and tables are worked out again here.

Each has ``check(cfg, wl, blocks, start, kept, device, control=False)``: for
the stream's first block ``start`` and the window blocks ``kept`` (each with
its index, the state views before and after, and the entry's outputs), the
numbers compared, one dict a block, and what it counted on the way. With
``control``, the reference computed in the next precision below the
configuration's stands in the program's place.
"""
