"""Host-side native code of the port: the kd-tree of point-cloud meshes."""
