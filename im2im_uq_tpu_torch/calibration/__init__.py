"""RCPS calibration."""
