"""The port's serving engine (counterpart of ``repro.serve``)."""
