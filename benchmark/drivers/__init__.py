"""One driver per traffic kind (a traffic file's ``kind``).  Each has
``Program(cell, seed, device)`` (set-up: the program built from the seed and
warmed, its checked work done), ``Program.window(seconds, trace)``,
``Program.finish()`` (what the reference judges; frees the program),
``compare(cell, seed, outputs, device)`` (the reference's readings),
``control(cell, seed, device)`` (the reference, one precision step down, in
the program's place) and ``plant(fault)`` (a fault under the program, for
the benchmark's tests and readings)."""
