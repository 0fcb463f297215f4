"""Host-side data of the port: counterpart of ``pcp_tpu/datasets`` (so far
the ego's reading of the exchange; the rest is ROADMAP A8)."""
