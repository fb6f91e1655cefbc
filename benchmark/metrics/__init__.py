"""Per-layer metric readers.  A per-layer metric ``<name>`` of
``BENCHMARK.json`` has a parameter file ``metrics/<name>.json`` whose
``reader`` names a module here; its ``read(stretch, params, cell)`` returns
the value from a traced stretch, or None when the stretch holds nothing to
read, and the metric is then left out of the result line."""
