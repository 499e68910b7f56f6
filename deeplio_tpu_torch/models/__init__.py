"""Model zoo: PointSeg blocks, DeepLIO feature nets, the flax weight
bridge (both ways)."""
