"""The frozen yardstick: statistics, peaks, traces, work counts, inputs."""
