"""Frozen numpy copies of the seeded topology and traffic constructions."""
