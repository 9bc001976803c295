"""The port's launchers (counterpart of ``repro.launch``)."""
