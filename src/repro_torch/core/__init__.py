"""The port's copy of the parts of ``repro.core`` a job needs."""
