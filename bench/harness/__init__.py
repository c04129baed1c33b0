"""The benchmark's general machinery: the manifest, the run of one cell
(set-up, measured window, traced fit), the reduction of a profiler trace
and the result line.  Everything that belongs to one configuration, traffic
mix, per-layer metric or reference piece lives in a file of its own
(`configs/`, `data/`, `traffic/`, `limits/`, `metrics/`, `reference/`,
`counts/`) and is found by name."""
