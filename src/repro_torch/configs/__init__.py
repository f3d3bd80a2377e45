"""Model configurations of the architectures the port runs (own copies of
``repro/configs``; ``registry.get_config`` maps ``--arch`` to one)."""
