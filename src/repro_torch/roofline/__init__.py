"""H100 roofline terms of the dry-run's counts and of each kernel's work."""
