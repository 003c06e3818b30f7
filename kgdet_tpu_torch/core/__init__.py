"""Post-processing of head outputs into detections."""
