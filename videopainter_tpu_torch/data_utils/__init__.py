"""Dataset preparation: CSV-driven video download and archive extraction."""
