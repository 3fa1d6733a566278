"""Padded graph batches and masked segment reductions."""
