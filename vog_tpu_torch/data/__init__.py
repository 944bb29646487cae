"""Device-resident feature tables."""
