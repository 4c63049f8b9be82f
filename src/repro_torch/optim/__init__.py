"""AdamW over the model's named parameters (``repro.optim``)."""
