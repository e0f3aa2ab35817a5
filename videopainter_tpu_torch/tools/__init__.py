"""Command-line tools of the port (run as `python -m videopainter_tpu_torch.tools.<name>`)."""
