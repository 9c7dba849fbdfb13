"""The stateless data pipeline (``pipeline``)."""
