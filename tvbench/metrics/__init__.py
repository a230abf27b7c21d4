"""Per-layer metrics, one reader a file, found by the metric's name:
`read(readings)` gives the number or None where there is nothing to read."""
