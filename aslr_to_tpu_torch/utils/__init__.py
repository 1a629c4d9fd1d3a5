"""Solution metrics and the per-iteration table (``metrics``, ``verbose``)."""
