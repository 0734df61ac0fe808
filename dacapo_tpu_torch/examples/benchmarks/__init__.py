"""Benchmark programs: `trace(dirs, cst_dirs, nt, ...)` writes <Name>.eir.json + .cst."""
