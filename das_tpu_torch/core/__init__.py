"""Points and the fused decode."""
