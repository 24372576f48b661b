"""Analysis tools: curve bases, the descriptor evaluation and the plots."""
