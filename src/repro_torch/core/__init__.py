"""Plans, Green's functions, transforms, the stage engine and the solver."""
