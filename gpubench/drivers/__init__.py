"""Program drivers, one file per kind of configuration."""
