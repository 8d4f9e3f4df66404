"""Validation, tests, generation and dataset encoding; on the card each runs
as a captured program (``programs.py``)."""
