"""The system under test, built from a configuration file."""
