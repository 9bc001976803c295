"""Hardware figures of the port's target card (counterpart of
``repro.roofline``)."""
