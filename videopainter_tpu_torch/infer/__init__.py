"""Inference entry points: `inpaint` (the CSV-row CLI), `edit` (instruction
edits and their benchmark sweep) and `first_frame` (the T=1 pre-inpaint hook)."""
