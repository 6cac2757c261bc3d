from .perplexity import causal_lm_loss, evaluate_perplexity

__all__ = ["causal_lm_loss", "evaluate_perplexity"]
