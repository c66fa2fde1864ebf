"""APLA parameter surgery (port of apla_tpu.apla)."""
