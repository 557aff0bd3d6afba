"""Packaging tools: the options schema a framework's YAMLs render
with."""
