"""The yardstick shared by every cell: the manifest and the files it names,
weights and traffic from the seed, the analytic counts and peaks, the
reduction of a device trace, the comparisons that decide ``correct`` and the
result line."""
