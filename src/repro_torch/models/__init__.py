"""The port's models (counterpart of ``repro.models``): dense transformers
with prefill and decode."""
