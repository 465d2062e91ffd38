"""Model assembly: the manifest layer table → port units."""
