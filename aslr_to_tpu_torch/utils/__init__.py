"""Utilities: solution metrics, the per-iteration table, the finite-difference
oracle, the native rigid-body oracle, the URDF parser and trajectory io
(``metrics``, ``verbose``, ``numdiff``, ``native``, ``urdf``, ``io``)."""
