"""Search spaces, objectives, GP surrogate, runner and engine of the port."""
