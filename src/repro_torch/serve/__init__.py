"""Serving: the decode engine and token sampling."""
