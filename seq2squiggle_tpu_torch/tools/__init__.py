"""Standalone data tools."""
