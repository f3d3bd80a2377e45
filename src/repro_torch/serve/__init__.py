"""Serving: cache construction, prefill, the one-token decode step and the
samplers (counterpart of ``repro/serve``)."""
