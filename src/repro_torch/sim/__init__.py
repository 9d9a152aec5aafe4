"""Event taxonomy and scheduler factory shared with the live cascade."""
