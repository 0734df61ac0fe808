"""hc-test runs: `run(pipeline, waterline, profile, ...)` of each benchmark."""
