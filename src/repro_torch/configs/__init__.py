"""Architecture configurations the port can run (``repro.configs``)."""
