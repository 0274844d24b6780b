"""The benchmark's machinery: finding a cell's files by name, timing the
window, reading the profiler's trace, and composing the result line.

Nothing here knows a configuration, a traffic mix, a pipeline or a
metric: those are files of their own under ``portbench/`` that the
harness finds by the names ``BENCHMARK.json`` gives."""
