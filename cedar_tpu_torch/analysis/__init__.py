"""Policy-set analysis. The port holds only the serving-partition prune
checks (partition.py) that the incremental compiler imports."""
