"""Architecture configs; see registry.ARCH_IDS / registry.get_config."""
