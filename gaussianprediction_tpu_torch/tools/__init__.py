"""The port's tools: quality_proxy (the quality protocol on the card)."""
