"""The port's data pipeline (counterpart of ``repro.data``)."""
