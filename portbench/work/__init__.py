"""The bytes and operations of each kernel's function at a cell's shapes,
one file a function: ``work(cfg, wl, info) -> (bytes, operations) | None``.
Bytes count each input byte read once and each output byte written once;
operations the fewest real multiplies and adds that compute the function (a
transcendental or a division counts as one). The counts are those of
``chip_smoke.py::kernel_work`` (chip_smoke.py:3792-3849), made functions of
the shapes; they count the function, not whichever kernel computes it."""
