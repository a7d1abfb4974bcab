"""The plain reference of the GSON iteration and the comparison."""
