"""Host-only utilities copied from ``znicz_tpu.utils``."""
