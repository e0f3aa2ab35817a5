"""The interactive demo (`app.py`): click to segment, track, inpaint."""
