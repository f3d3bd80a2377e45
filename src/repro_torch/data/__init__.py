"""The synthetic LM data pipeline (counterpart of ``repro/data``)."""
