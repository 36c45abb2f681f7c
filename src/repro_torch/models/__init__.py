"""The dense decoder (configs in ``repro_torch.configs``) that embeds documents into ProMiSH points."""
