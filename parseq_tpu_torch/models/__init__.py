"""Model families of the port: PARSeq on a ViT encoder."""
