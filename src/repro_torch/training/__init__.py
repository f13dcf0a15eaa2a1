"""Training of the port: ``optimizer`` (AdamW, Adafactor), ``compress``
(error-feedback int8 gradients) and ``train_step`` (loss, backward,
microbatch accumulation, the optimizer step)."""
