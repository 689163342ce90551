"""Model families: how the harness builds a configuration in the port,
drives one call, and judges it against the reference. A configuration
file names its family; a family is a module of this package."""
