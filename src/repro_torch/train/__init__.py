"""Training of the port: the optimizer, the train step and the
``Trainer`` (``repro/train``)."""
