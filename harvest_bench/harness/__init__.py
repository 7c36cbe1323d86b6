"""The general parts of the harness: spec loading, traffic, weights, the
closed loop, statistics, tracing, work counting and the correctness check."""
