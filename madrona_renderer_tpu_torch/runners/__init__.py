"""Built-in scenes."""
