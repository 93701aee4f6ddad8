"""Configuration and sequence helpers of the port."""
