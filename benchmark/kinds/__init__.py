"""The kinds of cell, one module each, found by a traffic mix's ``kind``:
``kinds/<kind>.py`` with ``run(cell, seed, seconds, trace, device,
t_start, opts=())`` that returns a ``cells.Outcome``."""
