"""Counterparts of ``experiments/hw_performance/``: the cost model and the
LLM.int8() outlier census."""
