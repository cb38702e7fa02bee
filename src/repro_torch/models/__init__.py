"""Model configs, float init and the integer serving datapath."""
