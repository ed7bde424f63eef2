"""Plans, the ADI operator, the Cahn–Hilliard solver and its metrics."""
