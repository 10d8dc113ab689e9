"""Input generators: each ``make(cfg, wl, seed, device)`` returns the input
cycle, a tensor [n_blocks, C, T] of complex64 blocks made on ``device`` from
``seed``; the window streams it block by block, cycled."""
