"""Scheduler core: decision math, statistic log, policies, engine and the
paper's §4 simulation harness."""
