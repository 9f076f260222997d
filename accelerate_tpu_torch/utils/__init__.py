"""Config dataclasses and the serving error taxonomy of the port."""
