"""The benchmark LM the paper tables train (port of ``benchmarks/common.py``)."""
