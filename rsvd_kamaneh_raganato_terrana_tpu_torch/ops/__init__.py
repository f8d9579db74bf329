"""Primitive products (`primitives`)."""
