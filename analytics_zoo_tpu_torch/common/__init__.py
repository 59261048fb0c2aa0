"""Device choice and configuration."""
