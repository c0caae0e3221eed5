"""Core math: quaternions, frames and motion functions."""
