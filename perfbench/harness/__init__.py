"""The benchmark's own code: cell files, traffic, weights, the timed
window, the profiler's reduction, the work counts and the check."""
