"""Models of the port: ModelB2, its BN-folded serving form and the int8 step."""
