"""One reader a per-layer metric, found by the metric's name: each file
defines ``read(run)``, which returns the metric's value or None where the
run holds nothing to read (the harness then leaves the metric out)."""
