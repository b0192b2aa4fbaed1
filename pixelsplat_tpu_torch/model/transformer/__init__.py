"""The generic pre-norm transformer stack."""
