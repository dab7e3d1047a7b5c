"""Architecture configs of the port (``base.get_config``, ``list_configs``)."""
