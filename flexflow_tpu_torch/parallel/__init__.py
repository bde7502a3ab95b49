"""Multi-rank execution: the ranks' collectives and ring attention."""
