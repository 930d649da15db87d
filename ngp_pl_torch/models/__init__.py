"""The radiance field, the occupancy grid and the test-view renderer."""
