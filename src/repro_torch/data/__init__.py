"""Synthetic arithmetic chain-of-thought task and its toy tokenizer."""
