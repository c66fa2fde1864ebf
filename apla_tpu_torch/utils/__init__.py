"""Host-side helpers (port of apla_tpu.utils)."""
