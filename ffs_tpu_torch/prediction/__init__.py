"""Spot prediction: rotation (Reeke-equivalent) and stills predictors."""
