"""Attention, projection and dense ops (port of apla_tpu.ops)."""
