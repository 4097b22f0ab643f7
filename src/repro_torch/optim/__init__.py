"""AdamW and the LR schedule (port of ``repro/optim``)."""
