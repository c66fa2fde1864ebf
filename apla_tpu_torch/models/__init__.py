"""ViT backbone and classifier (port of apla_tpu.models)."""
