"""Architecture configs the port serves (pure data)."""
